"""Prefetching host loader of packed pair batches (port of
``d3feat_tpu.data.loader``, copied as it is).

The host only augments, samples correspondences and packs each pair into
the static layout (``data.pack.pack_pair``, called by the dataset's
``packed``); the pyramid is built on the device. That is cheap enough for
a thread pool with a bounded, stop-aware prefetch queue (no process fork,
no serialization). A worker's exception is raised in the consumer.

Each yielded batch stacks ``num_devices`` pairs along a leading axis (the
last group of an epoch filled by wrapping around to its first indices);
the port's ``Trainer`` runs one device and takes ``batch[k][0]``.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np


def _to_batch_dict(packed) -> Dict[str, np.ndarray]:
    return {
        "points": packed.points,
        "features": packed.features,
        "lengths": packed.lengths,
        "corr": packed.corr,
        "corr_valid": packed.corr_valid,
        "dist_keypts": packed.dist_keypts,
    }


class PairLoader:
    """Iterable over stacked packed-pair batches with background prefetch.

    Args:
      dataset: object with ``__len__`` and ``packed(index, point_capacity=,
        corr_capacity=)``.
      point_capacity / corr_capacity: static shapes for packing.
      num_devices: pairs per yielded batch (leading axis).
      max_iter: cap on yielded batches per epoch (reference
        training_max_iter / val_max_iter, config.py:65-66).
    """

    def __init__(
        self,
        dataset,
        *,
        point_capacity: int,
        corr_capacity: int,
        num_devices: int = 1,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        max_iter: Optional[int] = None,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.point_capacity = point_capacity
        self.corr_capacity = corr_capacity
        self.num_devices = num_devices
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.max_iter = max_iter
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_devices
        if not self.drop_last and len(self.dataset) % self.num_devices:
            n += 1
        return min(n, self.max_iter) if self.max_iter else n

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n_batches = len(self)
        indices = self._epoch_indices()
        d = self.num_devices

        def load_one(i: int):
            return _to_batch_dict(
                self.dataset.packed(
                    int(i), point_capacity=self.point_capacity,
                    corr_capacity=self.corr_capacity,
                )
            )

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def stop_aware_put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        group = indices[b * d : b * d + d]
                        if len(group) < d:  # wrap-around fill, last batch
                            group = np.concatenate(
                                [group, indices[: d - len(group)]])
                        parts = list(pool.map(load_one, group))
                        out = {
                            k: np.stack([p[k] for p in parts], axis=0)
                            for k in parts[0]
                        }
                        stop_aware_put(out)
            except BaseException as e:  # noqa: BLE001
                # surface worker failures to the consumer — a silently dead
                # producer would leave the consumer blocked on q.get()
                stop_aware_put(e)
                return
            # the terminal sentinel must also be stop-aware: a blocking put
            # against a full queue would leak this thread (and its
            # prefetched batches) if the consumer abandoned iteration
            stop_aware_put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
