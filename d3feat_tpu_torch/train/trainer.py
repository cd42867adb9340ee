"""Epoch-loop trainer (port of ``d3feat_tpu.train.trainer``).

The reference Trainer's control flow (reference: trainer.py:9-228), kept
statement for statement from the JAX package: per-epoch train + validate,
best-loss/best-acc snapshots, periodic snapshots and ``model_final``,
ExponentialLR stepped per ``scheduler_interval`` epochs, non-finite-gradient
step skipping, autoexport of the portable npz on a new best accuracy, and
resume from a snapshot or warm start from an npz. Each iteration is the
port's ``make_train_step`` (pyramid, forward, losses, backward, update on
the card, K1-K5), which copies its metrics to the host once per step; the
JAX package's batched drain of device metrics has no counterpart.

``num_devices > 1`` is the JAX package's data-parallel branch
(``d3feat_tpu/train/trainer.py:67-80``) on ``torch.distributed``: one
process per device (``torchrun --nproc_per_node N``), in an initialised
default process group of exactly ``num_devices`` ranks
(``parallel.mesh.init_group``). Every rank runs the same loader (it
stacks ``num_devices`` pairs a batch), takes pair ``rank``, and steps with
the averaged gradients and metrics (``parallel.data_parallel``), so every
rank holds the same weights and takes the same decisions; rank 0 alone
writes the snapshots, the metrics log and the autoexport.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from d3feat_tpu_torch import resolve_device
from d3feat_tpu_torch.models.kpfcnn import init_kpfcnn
from d3feat_tpu_torch.ops.pyramid import make_pyramid_spec
from d3feat_tpu_torch.parallel.data_parallel import make_dp_eval_step, make_dp_train_step
from d3feat_tpu_torch.parallel.mesh import rank_device, shard_batch
from d3feat_tpu_torch.train.checkpoint import BEST_ACC, BEST_LOSS, SnapshotManager
from d3feat_tpu_torch.train.logging_utils import MetricsLogger
from d3feat_tpu_torch.train.optim import make_optimizer
from d3feat_tpu_torch.train.step import TrainState, make_eval_step, make_train_step
from d3feat_tpu_torch.utils.timer import AverageMeter, Timer

_METRIC_KEYS = ("loss", "desc_loss", "det_loss", "accuracy", "d_pos", "d_neg")


class Trainer:
    """Drives training of KPFCNN on fragment-pair loaders.

    Args:
      config: D3FeatConfig.
      train_loader / val_loader: iterables of stacked batch dicts (leading
        axis = config.num_devices), e.g.
        :class:`d3feat_tpu_torch.data.loader.PairLoader`.
      device: ``"cuda"`` (the kernels, on the rank's own card; raises
        without CUDA) or ``"cpu"`` (their plain twins).

    The model starts from ``init_kpfcnn(config, seed=config.seed)``, or
    from ``config.pretrain``.
    """

    def __init__(self, config, train_loader, val_loader=None,
                 snapshot_dir: Optional[str] = None, verbose: Optional[bool] = None,
                 device="cuda"):
        self.rank = 0
        if config.num_devices > 1:
            n = dist.get_world_size() if dist.is_initialized() else 0
            if n != config.num_devices:
                raise RuntimeError(
                    f"num_devices={config.num_devices} needs an initialised process group "
                    f"of that size (parallel.mesh.init_group; torchrun --nproc_per_node "
                    f"{config.num_devices}), have {n or 'none'}")
            self.rank = dist.get_rank()
        self.device = (rank_device(device, self.rank) if config.num_devices > 1
                       else resolve_device(device))
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.verbose = (config.verbose if verbose is None else verbose) and self.rank == 0

        self.pyramid_spec = make_pyramid_spec(config)
        if config.num_devices > 1:
            self._train_step = make_dp_train_step(config, pyramid_spec=self.pyramid_spec)
            self._eval_step = make_dp_eval_step(config, pyramid_spec=self.pyramid_spec)
        else:
            self._train_step = make_train_step(config, self.pyramid_spec)
            self._eval_step = make_eval_step(config, self.pyramid_spec)
        model = init_kpfcnn(config, seed=config.seed, device=self.device)
        self.state = TrainState(model, make_optimizer(config, model))

        snapshot_dir = snapshot_dir or os.path.join(
            config.snapshot_root, config.experiment_id
        )
        # every rank reads snapshots (a resume), rank 0 alone writes
        self.snapshots = SnapshotManager(snapshot_dir, config if self.rank == 0 else None)
        self.logger = MetricsLogger(snapshot_dir) if self.rank == 0 else None
        self.data_timer, self.step_timer = Timer(), Timer()

        self.start_epoch = 0
        self.best_loss = float("inf")
        self.best_acc = 0.0
        self.global_iter = 0
        if config.pretrain:
            self._load_pretrain(config.pretrain)

    # ------------------------------------------------------------------
    def _device_put(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """This rank's pair of a stacked batch, as tensors on its device."""
        return shard_batch(batch, self.rank, self.device, self.config.num_devices)

    def _log(self, tag_values, step: int, prefix: str) -> None:
        if self.logger is not None:
            self.logger.log(tag_values, step, prefix=prefix)

    def _load_pretrain(self, name: str) -> None:
        """Resume from a snapshot name inside the snapshot dir, or a path.

        A ``.npz`` path warm-starts from a portable params-only artifact
        (compat/portable.py): the model's weights are restored, the
        optimizer state stays fresh (momentum rebuilds within ~1/(1-beta)
        steps) and the epoch counter / bests come from the artifact's meta.
        """
        if name.endswith(".npz"):
            from d3feat_tpu_torch.compat.weights import load_npz

            meta = load_npz(self.state.model, name)
            self.start_epoch = int(meta.get("epoch", 0))
            self.best_loss = float(meta.get("best_loss", float("inf")))
            self.best_acc = float(meta.get("best_acc", 0.0))
            self.global_iter = self.start_epoch * min(
                len(self.train_loader), self.config.training_max_iter)
            if self.verbose:
                print(f"[trainer] warm-started {name!r} at epoch "
                      f"{self.start_epoch} (best_acc {self.best_acc:.2f}%)")
            return
        mgr = self.snapshots
        if os.path.isabs(name) or os.sep in name:
            mgr = SnapshotManager(os.path.dirname(name))
            name = os.path.basename(name)
        self.state, meta = mgr.restore(name, self.state)
        self.start_epoch = int(meta["epoch"])
        self.best_loss = float(meta["best_loss"])
        self.best_acc = float(meta["best_acc"])
        # keep the train/ step axis monotone across resumes (epochs run
        # exactly min(len(loader), training_max_iter) steps unless the
        # loader is exhausted early, which the corpus loader never is)
        self.global_iter = self.start_epoch * min(
            len(self.train_loader), self.config.training_max_iter
        )
        if self.verbose:
            print(f"[trainer] resumed {name!r} at epoch {self.start_epoch}")

    # ------------------------------------------------------------------
    def train(self) -> TrainState:
        """Full schedule (reference: trainer.py:39-68)."""
        for epoch in range(self.start_epoch, self.config.max_epoch):
            self.train_epoch(epoch)
            if self.val_loader is not None:
                res = self.evaluate(epoch)
                if res["loss"] < self.best_loss:
                    self.best_loss = res["loss"]
                    self._snapshot(BEST_LOSS, epoch)
                if res["accuracy"] > self.best_acc:
                    self.best_acc = res["accuracy"]
                    self._snapshot(BEST_ACC, epoch)
                    self._autoexport(epoch)
            if (epoch + 1) % self.config.snapshot_interval == 0:
                self._snapshot(f"snapshot_epoch_{epoch + 1}", epoch)
        self._snapshot("model_final", self.config.max_epoch - 1)
        return self.state

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch; the data and step timers (``data_timer``,
        ``step_timer``) restart with it."""
        cfg = self.config
        meters = {k: AverageMeter() for k in _METRIC_KEYS + ("skipped", "overflow")}
        data_timer, step_timer = self.data_timer, self.step_timer
        data_timer.reset()
        step_timer.reset()

        it = iter(self.train_loader)
        for i in range(min(len(self.train_loader), cfg.training_max_iter)):
            data_timer.tic()
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = self._device_put(batch)
            data_timer.toc()

            step_timer.tic()
            # the step returns its metrics on the host (one copy a step)
            self.state, m = self._train_step(self.state, batch, epoch)
            for k in _METRIC_KEYS:
                meters[k].update(float(getattr(m, k)))
            meters["skipped"].update(float(m.skipped))
            meters["overflow"].update(float(m.overflow))
            step_timer.toc()
            self.global_iter += 1

            if self.global_iter % 100 == 0:
                self._log(
                    {
                        "Desc_Loss": meters["desc_loss"].avg,
                        "Det_Loss": meters["det_loss"].avg,
                        "D_pos": meters["d_pos"].avg,
                        "D_neg": meters["d_neg"].avg,
                        "Accuracy": meters["accuracy"].avg,
                        "lr": float(m.lr),
                        # nonzero => static capacities too small for this
                        # data: raise the config's caps
                        "Overflow": meters["overflow"].avg,
                    },
                    self.global_iter, prefix="train/",
                )
                if self.verbose:
                    print(
                        f"epoch {epoch} iter {i}: loss {meters['loss'].avg:.4f} "
                        f"acc {meters['accuracy'].avg:.2f}% "
                        f"data {data_timer.avg * 1e3:.1f}ms "
                        f"step {step_timer.avg * 1e3:.1f}ms"
                    )
        return {k: m.avg for k, m in meters.items()}

    def evaluate(self, epoch: int) -> Dict[str, float]:
        cfg = self.config
        meters = {k: AverageMeter() for k in _METRIC_KEYS}
        it = iter(self.val_loader)
        for _ in range(min(len(self.val_loader), cfg.val_max_iter)):
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = self._device_put(batch)
            m = self._eval_step(self.state.model, batch)
            for k in _METRIC_KEYS:
                meters[k].update(float(getattr(m, k)))
        res = {k: m.avg for k, m in meters.items()}
        self._log(
            {"Loss": res["loss"], "Accuracy": res["accuracy"],
             "Desc_Loss": res["desc_loss"], "Det_Loss": res["det_loss"]},
            epoch, prefix="val/",
        )
        if self.verbose:
            print(f"[val] epoch {epoch}: loss {res['loss']:.4f} "
                  f"acc {res['accuracy']:.2f}%")
        return res

    def _autoexport(self, epoch: int) -> None:
        """Portable npz of the new best-acc weights (config.autoexport).

        Written atomically (tmp + rename) so a reset mid-write can't
        corrupt the artifact; failure to export never kills the run.
        """
        path = self.config.autoexport
        if not path or self.rank != 0:
            return
        try:
            from d3feat_tpu_torch.compat.weights import export_model_npz

            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = path + ".tmp.npz"
            export_model_npz(
                tmp, self.state.model,
                meta={"epoch": epoch + 1, "best_loss": self.best_loss,
                      "best_acc": self.best_acc,
                      "config": self.config.to_dict()},
            )
            os.replace(tmp, path)
            if self.verbose:
                print(f"[trainer] autoexport {path!r} @ epoch {epoch} "
                      f"(best_acc {self.best_acc:.2f}%)")
        except Exception as e:  # noqa: BLE001 — never take down training
            print(f"[trainer] autoexport FAILED: {e!r}")

    def _snapshot(self, name: str, epoch: int) -> None:
        if self.rank != 0:
            return
        self.snapshots.save(
            name, self.state, epoch=epoch + 1,
            best_loss=self.best_loss, best_acc=self.best_acc,
        )
        if self.verbose:
            print(f"[trainer] snapshot {name!r} @ epoch {epoch}")
