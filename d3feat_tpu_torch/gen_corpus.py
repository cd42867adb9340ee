"""Pre-generate a disk corpus of world-frame scan scenes for training (port
of the JAX package's ``tools/gen_corpus.py``, which imports JAX).

The ray-traced fused-scan generation (about a second a scene on one CPU
core) cannot keep up with the train step, so the expensive half of every
training pair (``data.synthetic.scan_pair_world``: two overlapping fused
depth scans of one room + up to 1024 candidate GT correspondences, all in
world frame) is generated ahead of time and written as one
``scene_<i>.npz`` (``w0``, ``w1``, ``pairs``) per scene. Training then uses
``DiskScanPairDataset``, which applies only the cheap per-visit
augmentation at load time. Scenes whose number is a multiple of
``DiskScanPairDataset.VAL_MOD`` (50) are its validation role.

Writes are atomic (tmp + rename) and existing scenes are skipped, so the
tool is resumable and can keep running in the background while training
reads the same directory. Host numpy: the same seed gives the JAX tool's
files.

Run from the repository root::

    python3 -m d3feat_tpu_torch.gen_corpus --out runs/corpus --count 30000 \\
        [--seed 777] [--max-points 30000] [--nice]
"""

import argparse
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/corpus")
    ap.add_argument("--count", type=int, default=30000)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--max-points", type=int, default=30000,
                    help="crop scenes whose pair exceeds this many points "
                         "(keeps every pair inside the static L0 capacity)")
    ap.add_argument("--min-corr", type=int, default=192,
                    help="skip scenes with fewer candidate correspondences")
    ap.add_argument("--resolution", type=int, nargs=2, default=(160, 120))
    ap.add_argument("--warp", type=float, default=1.5,
                    help="domain-warp amplitude (synthetic.make_warp_field);"
                         " 0 disables. Surface detail is what makes the"
                         " descriptor task learnable on synthetic rooms")
    ap.add_argument("--warp-max", type=float, default=0.0,
                    help="if > --warp, draw each scene's amplitude from "
                         "U(warp, warp_max)")
    ap.add_argument("--nice", action="store_true",
                    help="drop process priority to stay out of the way of "
                         "a concurrent training/bench process")
    return ap.parse_args(argv)


def write_scene(out: str, i: int, *, seed: int = 777, max_points: int = 30000,
                min_corr: int = 192, resolution=(160, 120), warp: float = 1.5,
                warp_max: float = 0.0) -> bool:
    """Generate scene ``i`` and write ``<out>/scene_<i:06d>.npz``; False when
    the scene is skipped (no usable draw, or fewer than ``min_corr``
    candidate pairs). The file is written to a dotted tmp name first, which
    the dataset's ``scene_*.npz`` glob never matches, then renamed."""
    from d3feat_tpu_torch.data.synthetic import crop_pair_to_budget, scan_pair_world

    rng = np.random.default_rng(seed * 1000003 + i)
    if warp_max > warp:
        warp = float(rng.uniform(warp, warp_max))
    try:
        w0, w1, pairs = scan_pair_world(
            rng, resolution=tuple(resolution), max_corr=1024, warp=warp)
    except RuntimeError:
        return False
    if len(w0) + len(w1) > max_points:
        # spatial crop to the budget, centred on a random GT-pair anchor
        # (so the crop keeps overlap): keeps the full scan density, which
        # the descriptor task depends on
        w0, w1, pairs = crop_pair_to_budget(rng, w0, w1, pairs, max_points)
    if len(pairs) < min_corr:
        return False
    # pid suffix: two concurrent generators over the same dir must not
    # collide on the tmp name
    tmp = os.path.join(out, f".tmp_{i:06d}.{os.getpid()}.npz")
    np.savez(tmp, w0=w0, w1=w1, pairs=pairs)
    os.replace(tmp, os.path.join(out, f"scene_{i:06d}.npz"))
    return True


def main(argv=None):
    args = parse_args(argv)
    if args.nice:
        os.nice(19)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    written = skipped = 0
    for i in range(args.count):
        if os.path.exists(os.path.join(args.out, f"scene_{i:06d}.npz")):
            continue
        if not write_scene(args.out, i, seed=args.seed, max_points=args.max_points,
                           min_corr=args.min_corr, resolution=args.resolution,
                           warp=args.warp, warp_max=args.warp_max):
            skipped += 1
            continue
        written += 1
        if written % 100 == 0:
            dt = time.time() - t0
            print(f"[gen_corpus] {written} written, {skipped} skipped, "
                  f"{dt / max(written, 1):.2f} s/scene", flush=True)
    print(f"[gen_corpus] done: {written} written, {skipped} skipped",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
