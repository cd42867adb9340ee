"""Configuration: a field-for-field copy of ``d3feat_tpu.config``.

The port keeps its own copy (it imports nothing of the JAX package) with the
same fields, defaults, ``architecture()`` and JSON round trip, so a config
written by either stack loads in the other. Knobs that only steer the JAX
package's TPU paths (``neighbor_search``, ``use_pallas``, ...) are kept for
that round trip; the port always runs the sorted-band path. ``get_config``
is the same argparse surface (every field as ``--name``, plus
``--cap_points``, ``--cap_neighbors`` and ``--cap_corr``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


@dataclass
class PyramidCaps:
    """Static per-level capacities replacing the reference's dynamic shapes.

    The reference derives per-batch neighbor-matrix widths from on-the-fly
    calibration (reference: datasets/dataloader.py:191-223) and lets every
    tensor take whatever row count the C++ subsampler produced. On TPU all
    shapes must be static, so each pyramid level gets a fixed point capacity
    and a fixed neighbor count; unused slots are shadow-padded (points at
    +1e6, neighbor index = capacity, zero features) which reproduces the
    reference's shadow-point semantics (reference: models/blocks.py:277,356,
    cpp_wrappers/cpp_neighbors/neighbors/neighbors.cpp:324).
    """

    # Max stacked point count per level (both clouds of a pair together).
    points: Tuple[int, ...] = (32768, 8192, 2048, 768, 256)
    # Max neighbors per query per level (conv + pool matrices).
    neighbors: Tuple[int, ...] = (40, 40, 40, 40, 40)
    # Correspondence capacity (>= num_node).
    corr: int = 128

    def __post_init__(self):
        self.points = tuple(int(p) for p in self.points)
        self.neighbors = tuple(int(n) for n in self.neighbors)
        if len(self.neighbors) != len(self.points):
            raise ValueError("points and neighbors must have the same length")

    @property
    def num_levels(self) -> int:
        return len(self.points)


@dataclass
class D3FeatConfig:
    """Full framework configuration.

    Field-for-field superset of the reference argparse config
    (reference: config.py:19-92); defaults match the reference defaults.
    """

    # --- snapshot (reference: config.py:21-25) ---
    experiment_id: str = field(default_factory=lambda: "D3Feat" + time.strftime("%m%d%H%M"))
    snapshot_root: str = "snapshot"
    snapshot_interval: int = 100

    # --- network (reference: config.py:28-46) ---
    num_layers: int = 5
    in_points_dim: int = 3
    first_features_dim: int = 128
    first_subsampling_dl: float = 0.03
    in_features_dim: int = 1
    conv_radius: float = 2.5
    deform_radius: float = 5.0
    num_kernel_points: int = 15
    KP_extent: float = 2.0
    KP_influence: str = "linear"  # 'constant' | 'linear' | 'gaussian'
    aggregation_mode: str = "sum"  # 'closest' | 'sum'
    fixed_kernel_points: str = "center"  # 'center' | 'verticals' | 'none'
    use_batch_norm: bool = False
    batch_norm_momentum: float = 0.02
    deformable: bool = False
    modulated: bool = False
    output_dim: int = 32  # descriptor dim (hard-coded 32 at reference blocks.py:406)
    num_classes: int = 40  # KPCNN classification head width (reference: architectures.py:119)

    # --- loss (reference: config.py:50-59) ---
    dist_type: str = "euclidean"
    desc_loss: str = "circle"  # 'contrastive' | 'circle'
    pos_margin: float = 0.1
    neg_margin: float = 1.4
    log_scale: float = 10.0
    safe_radius: float = 0.1
    desc_loss_weight: float = 1.0
    det_loss_weight: float = 1.0

    # --- optimizer (reference: config.py:63-73) ---
    optimizer: str = "SGD"  # 'SGD' | 'ADAM'
    max_epoch: int = 150
    training_max_iter: int = 3500
    val_max_iter: int = 500
    lr: float = 0.01
    weight_decay: float = 1e-6
    momentum: float = 0.98
    scheduler_gamma: float = 0.1 ** (1 / 80)
    scheduler_interval: int = 1
    # global-norm gradient clip; <= 0 disables (reference has none — its
    # only guard is the non-finite step skip, trainer.py:104-111)
    grad_clip_norm: float = 0.0

    # --- data (reference: config.py:77-86) ---
    root: str = "/data/3DMatch/"
    num_node: int = 128
    downsample: float = 0.03
    self_augment: bool = False
    augment_noise: float = 0.005
    augment_axis: int = 1
    augment_rotation: float = 1.0
    augment_translation: float = 0.5
    # rotation-frame distribution for the synthetic disk corpus (no
    # reference equivalent — real 3DMatch pairs come pre-framed):
    # 'axis' = the reference's 1-axis augmentation class; 'axis2' = both
    # clouds in independent single-axis frames (the held-out eval-scene
    # class); 'mix' = fair coin between the two per visit; 'so3' = full
    # independent SO(3) frames (stalls training from scratch)
    corpus_rotation: str = "axis"
    batch_size: int = 1  # pairs per device (the reference asserts 1; dataloader.py:73)
    num_workers: int = 4

    # --- misc (reference: config.py:90-92) ---
    verbose: bool = True
    pretrain: str = ""
    # portable params-only npz written (atomically, in place) on every
    # best-acc improvement, so a host reset loses at most one epoch of
    # trained state (the reference's torch.save snapshots live on the same
    # disk as the run, reference trainer.py:197-210 — this goes one step
    # further: the artifact is a single committable file). "" disables.
    autoexport: str = ""

    # --- TPU-native knobs (no reference equivalent) ---
    caps: PyramidCaps = field(default_factory=PyramidCaps)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' matmul inputs
    data_axis: str = "data"  # mesh axis name for data parallelism
    num_devices: int = 1  # data-parallel width (pairs processed per step)
    query_tile: int = 1024  # neighbor-search query tile size
    neighbor_search: str = "pallas"  # 'pallas' | 'banded' | 'brute' | 'grid'; pallas = banded
    # preprocessing + fused VMEM distance/select kernel (TPU only; falls back to
    # banded elsewhere). banded sorts by
    # the longest axis and searches a contiguous support band (TPU-friendly: no
    # gathers). 'grid' (cell hash) measured SLOWER on TPU v5e: gathers are VPU-bound.
    band_frac: float = 0.1  # banded: band margin ~ 2*frac*rows/clouds (overflow-flagged)
    cell_capacity: int = 32  # candidates per grid cell in the grid search
    use_pallas: bool = True  # use Pallas kernels where available (TPU only)
    # fused band-conv routing: layers whose [KP, Cin_pad128, Cout] f32
    # weight panel exceeds the VMEM budget fall back to the XLA gather
    # path (24 MB covers every layer of the default architecture; the
    # kernels raise Mosaic's scoped-VMEM limit accordingly)
    bandconv_max_panel_mb: float = 24.0
    bandconv_max_layer: int = 99  # debug: cap fused-path depth by layer
    # detector head on the TRAINING path: ride the fused band-head kernel
    # through its custom VJP (ops/pallas/head.band_head_ad) instead of the
    # XLA [C0, K0, D] gather + scatter-add backward. Eval/extract always
    # uses the fused head when band state is present.
    bandhead_train: bool = True
    # eval-time hard local-max gate (reference: architectures.py:361-366):
    # > 0 computes the [*, K0, D] gate gather only for the top-M points by
    # ungated score (gating only zeroes, so top-k keypoint selection is
    # exact whenever the top-M hold >= k detected points; 0 = gate every
    # point, bit-identical to the reference for all rows)
    eval_gate_topm: int = 0
    seed: int = 0
    deterministic_kernel_points: bool = True  # disable load-time rotation/jitter

    # ------------------------------------------------------------------
    def architecture(self) -> List[str]:
        """Block list for KPFCNN, derived from num_layers.

        Matches the list the reference builds inline
        (reference: training_3DMatch.py:44-56, test.py:155-167).
        """
        arch = ["simple", "resnetb"]
        for _ in range(self.num_layers - 1):
            arch += ["resnetb_strided", "resnetb", "resnetb"]
        for _ in range(self.num_layers - 2):
            arch += ["nearest_upsample", "unary"]
        arch += ["nearest_upsample", "last_unary"]
        return arch

    # --- JSON round trip -------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)

    @classmethod
    def from_dict(cls, d: dict) -> "D3FeatConfig":
        d = dict(d)
        caps = d.pop("caps", None)
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        cfg = cls(**kwargs)
        if caps is not None:
            cfg.caps = PyramidCaps(
                points=tuple(caps["points"]),
                neighbors=tuple(caps["neighbors"]),
                corr=int(caps.get("corr", 128)),
            )
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "D3FeatConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _add_bool(parser: argparse.ArgumentParser, name: str, default: bool, help: str = ""):
    parser.add_argument(
        name, type=lambda v: str(v).lower() in ("true", "1", "yes"), default=default, help=help
    )


def get_config(argv: Optional[Sequence[str]] = None) -> D3FeatConfig:
    """CLI entry mirroring the reference's argparse surface (config.py:95-97)."""
    defaults = D3FeatConfig()
    p = argparse.ArgumentParser(description="d3feat_tpu configuration")
    for f in dataclasses.fields(D3FeatConfig):
        if f.name in ("caps", "experiment_id"):
            continue
        default = getattr(defaults, f.name)
        flag = f"--{f.name}"
        if isinstance(default, bool):
            _add_bool(p, flag, default)
        else:
            p.add_argument(flag, type=type(default), default=default)
    p.add_argument("--experiment_id", type=str, default=defaults.experiment_id)
    p.add_argument("--cap_points", type=int, nargs="+", default=list(defaults.caps.points))
    p.add_argument("--cap_neighbors", type=int, nargs="+", default=list(defaults.caps.neighbors))
    p.add_argument("--cap_corr", type=int, default=defaults.caps.corr)
    args = p.parse_args(argv)
    d = vars(args)
    caps = PyramidCaps(
        points=tuple(d.pop("cap_points")),
        neighbors=tuple(d.pop("cap_neighbors")),
        corr=d.pop("cap_corr"),
    )
    cfg = D3FeatConfig.from_dict(d)
    cfg.caps = caps
    return cfg
