"""Training entry point of the port (port of the JAX package's
``train_3dmatch.py``).

Builds config + datasets + loaders and runs the port's ``Trainer`` (the
train step on the card, K1-K5). Run from the repository root::

    python3 -m d3feat_tpu_torch.train_3dmatch --root /data/3DMatch   # 3DMatch pickles
    python3 -m d3feat_tpu_torch.train_3dmatch --corpus runs/corpus   # a scan-scene corpus
    python3 -m d3feat_tpu_torch.train_3dmatch --scan                 # scan pairs drawn live
    python3 -m d3feat_tpu_torch.train_3dmatch --synthetic            # hermetic smoke run

Every field of the config is a flag (``--max_epoch 150``, ``--pretrain
artifacts/model_best_acc_r5.npz``, ``--cap_points ...``; see
``config.get_config``). ``--corpus DIR`` trains from a directory of
``scene_*.npz`` written by ``python3 -m d3feat_tpu_torch.gen_corpus`` (it may
keep growing while training runs), with fresh per-visit augmentation.
Snapshots (``torch.save`` directories) and ``metrics.jsonl`` go to
``<snapshot_root>/<experiment_id>``; ``--autoexport PATH`` writes the
portable npz on every new best accuracy. Without ``--cpu`` it needs a
CUDA device.

Data parallelism, one process per card::

    torchrun --nproc_per_node N -m d3feat_tpu_torch.train_3dmatch --corpus DIR --num_devices N

joins torchrun's process group (NCCL; gloo with ``--cpu``), and every
rank trains on its own pair of each stacked batch (``train.trainer``).
"""

import sys


def make_loaders(config, synthetic: bool, scan: bool = False,
                 corpus: str | None = None):
    from d3feat_tpu_torch.data.loader import PairLoader

    if corpus:
        from d3feat_tpu_torch.data.synthetic import DiskScanPairDataset

        # per-visit augmentation makes every epoch fresh; the corpus dir
        # may keep growing under a concurrent gen_corpus
        aug = dict(noise=config.augment_noise,
                   rotation=config.corpus_rotation,
                   augment_rotation=config.augment_rotation,
                   augment_translation=config.augment_translation)
        train_ds = DiskScanPairDataset(
            corpus, num_corr=config.num_node, seed=config.seed,
            role="train", **aug)
        val_ds = DiskScanPairDataset(
            corpus, num_corr=64, seed=config.seed + 7919,
            role="val", **aug)
    elif scan:
        from d3feat_tpu_torch.data.synthetic import ScanPairDataset

        train_ds = ScanPairDataset(
            size=max(32, config.training_max_iter), num_corr=config.num_node,
            seed=config.seed)
        val_ds = ScanPairDataset(
            size=max(8, config.val_max_iter), num_corr=64,
            seed=config.seed + 7919)
    elif synthetic:
        from d3feat_tpu_torch.data.synthetic import SyntheticPairDataset

        train_ds = SyntheticPairDataset(
            size=32, n_points=2000, num_corr=config.num_node, seed=config.seed
        )
        val_ds = SyntheticPairDataset(
            size=8, n_points=2000, num_corr=64, seed=config.seed + 1
        )
    else:
        from d3feat_tpu_torch.data.threedmatch import ThreeDMatchPairDataset

        kwargs = dict(
            root=config.root, num_node=config.num_node,
            downsample=config.downsample, self_augment=config.self_augment,
            augment_noise=config.augment_noise, augment_axis=config.augment_axis,
            augment_rotation=config.augment_rotation,
            augment_translation=config.augment_translation,
        )
        train_ds = ThreeDMatchPairDataset(split="train", seed=config.seed, **kwargs)
        # validation uses num_node=64 in the reference (training_3DMatch.py:96)
        val_kwargs = dict(kwargs, num_node=64)
        val_ds = ThreeDMatchPairDataset(split="val", seed=config.seed + 1,
                                        **val_kwargs)

    mk = lambda ds, max_iter, seed: PairLoader(  # noqa: E731
        ds, point_capacity=config.caps.points[0],
        corr_capacity=config.caps.corr, num_devices=config.num_devices,
        num_workers=config.num_workers, max_iter=max_iter, seed=seed,
    )
    return (
        mk(train_ds, config.training_max_iter, config.seed),
        mk(val_ds, config.val_max_iter, config.seed + 1),
    )


def main(argv=None):
    import torch

    from d3feat_tpu_torch.config import get_config
    from d3feat_tpu_torch.train.trainer import Trainer

    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {}
    for flag in ("--synthetic", "--scan", "--cpu"):
        flags[flag] = flag in argv
        if flags[flag]:
            argv.remove(flag)
    corpus = None
    if "--corpus" in argv:
        i = argv.index("--corpus")
        corpus = argv[i + 1]
        del argv[i : i + 2]
    config = get_config(argv)
    # the unary layers' f32 products in full f32, as the JAX package computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    train_loader, val_loader = make_loaders(config, flags["--synthetic"], flags["--scan"],
                                            corpus)
    device = "cpu" if flags["--cpu"] else "cuda"
    if config.num_devices > 1:
        import torch.distributed as dist

        from d3feat_tpu_torch.parallel.mesh import init_group

        init_group(device)
    try:
        Trainer(config, train_loader, val_loader, device=device).train()
    finally:
        if config.num_devices > 1:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
