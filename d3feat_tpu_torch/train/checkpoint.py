"""Snapshots with the reference's semantics (port of
``d3feat_tpu.train.checkpoint``).

The reference saves ``{epoch, state_dict, optimizer, scheduler, best_loss}``
periodically and keeps ``model_best_loss.pth`` / ``model_best_acc.pth`` on
validation improvement (reference: trainer.py:48-55,197-210); eval loads
``model_best_acc.pth`` (reference: test.py:181). Resume restores
model/optimizer/epoch (reference: trainer.py:212-225).

As in the JAX package a snapshot is a directory ``<name>/`` beside a JSON
sidecar ``<name>.meta.json`` (epoch, best metrics), and the snapshot
directory holds the run's ``config.json``. Where the JAX package writes an
Orbax checkpoint of its TrainState, the port's directory holds one
``torch.save`` file (``STATE_FILE``) of ``{"model": state_dict,
"optimizer": state_dict, "step": int}``. Neither stack reads the other's
snapshots; the portable npz (``compat/portable.py``) carries weights both
ways.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Tuple

import torch

from d3feat_tpu_torch.train.step import TrainState

BEST_ACC = "model_best_acc"
BEST_LOSS = "model_best_loss"
STATE_FILE = "train_state.pt"


class SnapshotManager:
    """Directory of named snapshots: periodic + best-loss + best-acc."""

    def __init__(self, directory: str, config=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if config is not None:
            config.to_json(os.path.join(self.directory, "config.json"))

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, name: str, state: TrainState, *, epoch: int,
             best_loss: float = float("inf"), best_acc: float = 0.0,
             overwrite: bool = True) -> None:
        path = self._path(name)
        if overwrite and os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(), "step": int(state.step)},
                   os.path.join(path, STATE_FILE))
        with open(path + ".meta.json", "w") as f:
            json.dump(
                {"epoch": epoch, "best_loss": best_loss, "best_acc": best_acc},
                f,
            )

    def _load(self, name: str, model: torch.nn.Module) -> Tuple[dict, dict]:
        """(the snapshot's ``torch.save`` dict with its tensors on the
        model's device, its meta), after loading its weights into
        ``model``."""
        path = self._path(name)
        saved = torch.load(os.path.join(path, STATE_FILE),
                           map_location=next(model.parameters()).device, weights_only=True)
        model.load_state_dict(saved["model"], strict=True)
        meta = {"epoch": 0, "best_loss": float("inf"), "best_acc": 0.0}
        meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta.update(json.load(f))
        return saved, meta

    def restore(self, name: str, template: TrainState
                ) -> Tuple[TrainState, dict]:
        """Load the snapshot into ``template``'s model and optimizer in place
        (tensors onto the model's device) and set its step count."""
        saved, meta = self._load(name, template.model)
        template.optimizer.load_state_dict(saved["optimizer"])
        template.step = int(saved["step"])
        return template, meta

    def restore_model(self, name: str, model: torch.nn.Module) -> dict:
        """Load only the snapshot's weights into ``model``; returns its meta."""
        return self._load(name, model)[1]

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    def latest_periodic(self) -> Optional[str]:
        snaps = [
            d for d in os.listdir(self.directory)
            if d.startswith("snapshot_epoch_")
            and os.path.isdir(self._path(d))
        ]
        if not snaps:
            return None
        return max(snaps, key=lambda d: int(d.rsplit("_", 1)[1]))
