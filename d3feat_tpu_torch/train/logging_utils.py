"""Training metrics logging: stdout + JSONL + optional TensorBoard (port of
``d3feat_tpu.train.logging_utils``, copied as it is).

Counterpart of the reference's tensorboardX scalar logging
(reference: trainer.py:121-127 train scalars every 100 iters,
trainer.py:57-58 val scalars per epoch) with the same scalar names, plus a
machine-readable JSONL stream (one line per flush) that needs no viewer.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, directory: str, use_tensorboard: bool = True):
        os.makedirs(directory, exist_ok=True)
        self.jsonl_path = os.path.join(directory, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(logdir=os.path.join(directory, "tensorboard"))
            except Exception:
                self._tb = None

    def log(self, tag_values: Dict[str, float], step: int,
            prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in tag_values.items():
            name = f"{prefix}{k}" if prefix else k
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
