"""Classification / segmentation metrics (port of
``d3feat_tpu.utils.metrics``, the numpy arithmetic copied as it is).

Counterpart of the reference's auxiliary metrics module
(reference: utils/metrics.py:6-57) — accuracy, per-class IoU, and IoU from
confusion matrices. Not used by the D3Feat descriptor path (the reference
imports but never calls them; trainer.py:6), kept for KPCNN-style
classification. Every argument may also be a torch tensor on any device
(KPCNN's logits on the card): it is copied to host numpy first.
"""

from __future__ import annotations

import numpy as np


def _host(x) -> np.ndarray:
    """ndarray (or anything ``np.asarray`` takes), or a torch tensor on any
    device copied to host numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(logits, labels) -> float:
    """Fraction of argmax predictions matching integer labels."""
    pred = np.argmax(_host(logits), axis=-1)
    labels = _host(labels)
    return float(np.mean(pred == labels))


def confusion_matrix(pred, labels, num_classes: int) -> np.ndarray:
    """[C, C] counts, rows = true class, cols = predicted class."""
    pred = _host(pred).reshape(-1)
    labels = _host(labels).reshape(-1)
    idx = labels * num_classes + pred
    return np.bincount(idx, minlength=num_classes**2).reshape(num_classes, num_classes)


def iou_from_confusion(conf) -> np.ndarray:
    """Per-class intersection-over-union from one or more confusion matrices.

    Accepts [..., C, C]; returns [..., C]. Classes absent from both prediction
    and ground truth get IoU equal to the mean of present classes (so they do
    not drag averages down), following the reference convention
    (reference: utils/metrics.py:28-57).
    """
    conf = np.asarray(_host(conf), dtype=np.float64)
    tp = np.diagonal(conf, axis1=-2, axis2=-1)
    fp = np.sum(conf, axis=-2) - tp
    fn = np.sum(conf, axis=-1) - tp
    denom = tp + fp + fn
    iou = tp / (denom + 1e-9)
    mask = denom < 1e-9
    counts = np.sum(~mask, axis=-1, keepdims=True)
    mean_present = np.sum(iou, axis=-1, keepdims=True) / np.maximum(counts, 1)
    return np.where(mask, mean_present, iou)


def iou(pred, labels, num_classes: int) -> np.ndarray:
    """Per-class IoU directly from predictions and labels."""
    return iou_from_confusion(confusion_matrix(pred, labels, num_classes))
